#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):
  1. print the card's name and power limit; build the CUDA kernels from
     ``src/repro_torch/csrc`` with nvcc and print the build time;
  2. hold each kernel against its plain PyTorch version on the card at
     shapes beyond the BoW path's (phase 5 repeats it on the path's tensors);
  3. train a BoW model on the CPU (explicit ``device="cpu"``): 1000
     ImageStream images at 32x32, a 250-word dictionary, the §4.5 config;
  4. move the model to the card and answer 4 requests of 256 test images
     through `pipeline.predict`: every kernel launched in every request,
     no plain version called, accuracy above chance, labels identical
     across two runs and in agreement with a CPU plain `predict`;
  5. on the first request's own tensors, hold each kernel against its plain
     version again, then time each kernel, its plain version and (for
     `linear_score`) one PyTorch call computing the same function;
  6. print the ``kernels`` JSON line, then the device line.

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

# H100 SXM peaks (NVIDIA data sheet, dense, 700 W): HBM bytes/s and fp32
# FLOP/s on CUDA cores (the kernels use no tensor cores)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12

PREDICT_BATCH = 256
N_REQUESTS = 4
N_TRAIN = 1000
DICT_SIZE = 250


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
        if s.op == "sep_filter":
            total += 2 * (s.weights[0].numel() + s.weights[1].numel())
        elif s.op == "erode":
            total += 2 * (2 * s.static[0])  # separable min: row + column compares
        else:
            total += 7  # grad_mag: 2 sub, 2 scale, 2 square, 1 add (+ sqrt)
    return total


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: no src/repro_torch under {ROOT}; run it in a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))

    from repro_torch.cv import classify, features, imgproc, pipeline
    from repro_torch.cv.config import PipelineConfig
    from repro_torch.data.synthetic import ImageStream
    from repro_torch.kernels import _build, counters, ref
    from repro_torch.kernels import bow as kbow
    from repro_torch.kernels import stencil

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    results = {"card": None, "checks": {}, "timing": {}, "predict": {}}

    # -- 1. card and build ---------------------------------------------------
    card = card_line()
    results["card"] = card
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} {torch.cuda.get_device_name(0)}")
    t_build = _build.build_all()
    print(f"build: {t_build:.2f} s (nvcc, sm_90a, {len(list(_build.CSRC.glob('*.cu')))} sources)")
    for name in ("stencil_chain", "bow"):
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas[{name}]: {line.strip()}")
    results["build_s"] = t_build

    pre_chain = (stencil.gaussian_stage(5), stencil.erode_stage(1), stencil.grad_stage())
    oct_chain = features.octave_chain(4)
    max_err = {k: 0.0 for k in counters.KERNELS}

    # -- 2. each kernel against its plain version on the card -----------------
    def check_chain(name, x, chain):
        got = stencil.fused_chain(x, chain)
        want = stencil.fused_chain(x, chain, mode="ref")
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
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
        print(f"check stencil_chain {name} {tuple(x.shape)}: bands={len(got)} max_err={err:.3g}")
        results["checks"][f"stencil_chain {name}"] = err
        max_err["stencil_chain"] = max(max_err["stencil_chain"], err)

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

    B, N, D, K, C = 1024, 32, 128, DICT_SIZE, 10
    descs = torch.rand((B, N, D), generator=gen, device=dev)
    descs = descs / descs.norm(dim=-1, keepdim=True)
    valids = torch.rand((B, N), generator=gen, device=dev) < 0.9
    cents = torch.rand((K, D), generator=gen, device=dev)
    cents = cents / cents.norm(dim=-1, keepdim=True)
    check_hist("random", descs, valids, cents)
    h = kbow.normalize_hist(kbow.quantize_hist_plain(descs, valids, cents))
    w = torch.randn((C, K), generator=gen, device=dev)
    b = torch.randn((C,), generator=gen, device=dev)
    check_score("random", h, w, b)

    # -- 3. train on the CPU, by explicit request ------------------------------
    cfg = PipelineConfig(preprocess=True, n_octaves=1, max_kp=32, head="svm")
    stream = ImageStream(res=32)
    imgs, labels = stream.batch(N_TRAIN, split="train")
    t0 = time.perf_counter()
    model_cpu = pipeline.train(
        imgs,
        labels,
        cfg,
        dict_size=DICT_SIZE,
        generator=torch.Generator().manual_seed(0),
        device="cpu",
    )
    t_train = time.perf_counter() - t0
    check(bool(torch.isfinite(model_cpu.centroids).all()), "train: non-finite centroids")
    print(f"train (CPU): {N_TRAIN} images, K={DICT_SIZE}, {t_train:.1f} s")

    # -- 4. the main path on the card: 4 requests through predict --------------
    test_imgs, test_labels = stream.batch(N_REQUESTS * PREDICT_BATCH, split="test")
    batches = test_imgs.split(PREDICT_BATCH)
    model_gpu = copy.deepcopy(model_cpu).to(dev)

    preds, per_batch, walls = [], [], []
    counters.reset()
    for xb in batches:
        before = counters.snapshot()
        timing = {}
        t0 = time.perf_counter()
        pb = pipeline.predict(model_gpu, xb, cfg, device=dev, timing=timing)
        walls.append(time.perf_counter() - t0)
        after = counters.snapshot()
        delta = {
            kind: {k: after[kind][k] - before[kind][k] for k in counters.KERNELS}
            for kind in ("launches", "plain_calls")
        }
        per_batch.append({"counters": delta, "timing": timing})
        preds.append(pb)
    main_path = counters.snapshot()
    for i, pb in enumerate(per_batch):
        c = pb["counters"]
        check(all(c["launches"][k] >= 1 for k in counters.KERNELS), f"batch {i}: {c}")
        check(all(v == 0 for v in c["plain_calls"].values()), f"batch {i}: plain ran: {c}")
        stages_s = {k: round(v, 5) for k, v in pb["timing"].items()}
        print(
            f"predict batch {i}: launches={c['launches']} plain_calls={c['plain_calls']} "
            f"stages_s={stages_s} wall_s={walls[i]:.4f}"
        )
    pred = torch.cat(preds).cpu()
    check(pred.shape == (len(test_labels),), f"predict: shape {tuple(pred.shape)}")
    acc = float((pred.long() == test_labels.long()).float().mean())
    print(f"accuracy: {acc:.4f} on {len(pred)} test images (chance 0.1, required > 0.15)")
    check(acc > 0.15, f"accuracy {acc} not above 0.15")

    again = torch.cat([pipeline.predict(model_gpu, xb, cfg, device=dev) for xb in batches]).cpu()
    check(torch.equal(pred, again), "labels differ between two runs on the card")
    print("determinism: labels identical across two runs on the card")

    cpu_pred = pipeline.predict(model_cpu, test_imgs, cfg, device="cpu")
    feats = pipeline.extract_features(test_imgs, cfg, device="cpu")
    plan = classify.build_plan(model_cpu, cfg, device="cpu")
    cpu_scores = plan.scores(plan.histograms(feats["desc"], feats["valid"]))
    mism = torch.nonzero(cpu_pred != pred).flatten().tolist()
    for i in mism:
        gap = float(cpu_scores[i, cpu_pred[i]] - cpu_scores[i, pred[i]])
        print(f"mismatch image {i}: card={int(pred[i])} cpu={int(cpu_pred[i])} cpu_gap={gap:.3g}")
    # the card and the CPU run the same arithmetic except f32 atan2/sqrt in the
    # descriptors, whose last ulp can move an orientation bin: allow 1%
    print(f"card vs CPU plain predict: {len(mism)} of {len(pred)} labels differ (limit 1%)")
    check(len(mism) <= 0.01 * len(pred), "card and CPU predictions disagree beyond 1%")
    results["predict"] = {
        "accuracy": acc,
        "mismatches_vs_cpu": len(mism),
        "train_s": t_train,
        "batches": per_batch,
        "wall_s": walls,
        "main_path_counters": main_path,
    }

    # -- 5. timing at the main path's shapes ----------------------------------
    xb = batches[0].to(dev).float()
    gray = features._normalize_gray(imgproc.preprocess_bow(xb))
    det = features.detect_keypoints(imgproc.preprocess_bow(xb), max_kp=cfg.max_kp)
    d = features.describe_keypoints(det)
    qd, qv = d["desc"].contiguous(), d["valid"]
    cents_g = model_gpu.centroids.contiguous()
    hist = kbow.bow_quantize_hist(qd, qv, cents_g)
    wg, bg = model_gpu.w.contiguous(), model_gpu.b.contiguous()
    # each kernel against its plain version on the main path's own tensors
    check_chain("preprocess main path", xb, pre_chain)
    check_chain("octave main path", gray[..., None], oct_chain)
    check_hist("main path", qd, qv, cents_g)
    check_score("main path", hist, wg, bg)
    f32 = 4
    pre_planes = ref.to_planes(xb)
    oct_planes = ref.to_planes(gray[..., None])
    n_pre, n_oct = pre_planes.numel(), oct_planes.numel()
    kernels = [
        {
            "name": "stencil_chain",
            "route": "cuda",
            "source": "src/repro_torch/csrc/stencil_chain.cu",
            "replaces": "src/repro/kernels/stencil/exec_window.py:427",
            "run": lambda: (
                stencil.fused_chain(xb, pre_chain),
                stencil.fused_chain(gray[..., None], oct_chain),
            ),
            "plain": lambda: (
                stencil.fused_chain(xb, pre_chain, mode="ref"),
                stencil.fused_chain(gray[..., None], oct_chain, mode="ref"),
            ),
            "library": None,
            # both launches of a request: inputs read once, every band written once
            "bytes": f32 * (2 * n_pre + n_oct * (1 + len(oct_chain))),
            "flops": n_pre * chain_flops(pre_chain) + n_oct * chain_flops(oct_chain),
        },
        {
            "name": "bow_quantize_hist",
            "route": "cuda",
            "source": "src/repro_torch/csrc/bow.cu",
            "replaces": "src/repro/kernels/bow.py:135",
            "run": lambda: kbow.bow_quantize_hist(qd, qv, cents_g),
            "plain": lambda: kbow.normalize_hist(kbow.quantize_hist_plain(qd, qv, cents_g)),
            "library": None,
            "bytes": f32 * (qd.numel() + qv.numel() + cents_g.numel() + hist.numel()),
            "flops": 2 * qd.shape[0] * qd.shape[1] * cents_g.shape[0] * qd.shape[2],
        },
        {
            "name": "linear_score",
            "route": "cuda",
            "source": "src/repro_torch/csrc/bow.cu",
            "replaces": "src/repro/kernels/bow.py:227",
            "run": lambda: kbow.linear_score(hist, wg, bg),
            "plain": lambda: kbow.linear_score_plain(hist, wg, bg),
            "library": lambda: torch.addmm(bg, hist, wg.T),
            "bytes": f32 * (hist.numel() + wg.numel() + bg.numel() + hist.shape[0] * wg.shape[0]),
            "flops": 2 * hist.shape[0] * wg.shape[0] * wg.shape[1],
        },
    ]
    lib_check = torch.addmm(bg, hist, wg.T)
    ok = torch.allclose(lib_check, kbow.linear_score(hist, wg, bg), rtol=1e-5, atol=1e-5)
    check(bool(ok), "linear_score disagrees with torch.addmm")
    line = []
    for k in kernels:
        # plain, kernel, kernel, plain: the two versions alternate on one card
        p1 = time_ms(k["plain"], iters=5)
        k1 = time_ms(k["run"], iters=50)
        k2 = time_ms(k["run"], iters=50)
        p2 = time_ms(k["plain"], iters=5)
        lib = time_ms(k["library"], iters=50) if k["library"] else None
        bms, by = bound_ms(k["bytes"], k["flops"])
        entry = {
            "name": k["name"],
            "route": k["route"],
            "source": k["source"],
            "replaces": k["replaces"],
            "launches": main_path["launches"][k["name"]],
            "max_abs_err": max_err[k["name"]],
            "ms": min(k1, k2),
            "plain_ms": min(p1, p2),
            "bound_ms": bms,
            "bound_by": by,
            "library_ms": lib,
        }
        line.append(entry)
        print(
            f"time {k['name']} batch={PREDICT_BATCH}: ms={k1:.5f}/{k2:.5f} "
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
