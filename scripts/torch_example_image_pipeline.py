"""Image-processing pipeline example: blur -> sharpen -> erode on a 1080p
frame, staged in plain PyTorch and as one fused launch (the counterpart of
`examples/image_pipeline.py`).

    PYTHONPATH=src python3 scripts/torch_example_image_pipeline.py [--device cpu]

The staged version runs the oracles of `kernels.ref` and the van Herk
erode; the fused version is one `stencil.fused_chain` launch over a batch of
two crops, counted by `kernels.counters`.  Runs on the card by default;
``--device cpu`` runs the kernels' plain versions.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.core.device import resolve_device  # noqa: E402
from repro_torch.cv import imgproc  # noqa: E402
from repro_torch.data.synthetic import ImageStream  # noqa: E402
from repro_torch.kernels import counters, ops, ref, stencil  # noqa: E402

SHARPEN = torch.tensor([[0, -1, 0], [-1, 5, -1], [0, -1, 0]], dtype=torch.float32)


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    dev = resolve_device(ap.parse_args().device)
    img = ImageStream().image((1080, 1920)).to(dev)
    k1 = ref.gaussian_kernel1d(5).to(dev)

    def staged(im):
        blur = ref.sep_filter2d_ref(im, k1, k1)
        edge = ref.filter2d_ref(blur, SHARPEN.to(dev))
        return imgproc.erode_vanherk(edge, 1)

    out = staged(img)
    sync(dev)
    t0 = time.perf_counter()
    out = staged(img)
    sync(dev)
    print(f"1080p blur->sharpen->erode, staged plain PyTorch: {time.perf_counter() - t0:.3f}s "
          f"on {dev}; out {tuple(out.shape)} {out.dtype}")

    crop = img[:256, :512].contiguous()
    a = ops.gaussian_blur(crop, 5)
    b = ref.sep_filter2d_ref(crop, k1, k1)
    print("gaussian_blur matches the oracle (<= 1):", int((a.int() - b.int()).abs().max()) <= 1)

    chain = (stencil.gaussian_stage(5), stencil.filter_stage(SHARPEN), stencil.erode_stage(1))
    batch = torch.stack([crop, crop])[..., None]  # (B, H, W, C)
    stencil.fused_chain(batch, chain)  # builds the kernel on the card's first call
    sync(dev)
    counters.reset()
    t0 = time.perf_counter()
    fused = stencil.fused_chain(batch, chain)
    sync(dev)
    n = sum(counters.LAUNCHES.values())
    print(f"fused 3-stage chain on {tuple(batch.shape)}: {time.perf_counter() - t0:.4f}s, "
          f"{n} kernel launch(es) on {dev}")
    oracle = ref.chain_ref(batch, chain)
    ok = int((fused.int() - oracle.int()).abs().max()) <= 1
    print("fused matches the chain oracle (<= 1):", ok)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
