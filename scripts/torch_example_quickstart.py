"""Quickstart: the paper's three algorithms through the port's public API
(the counterpart of `examples/quickstart.py`).

    PYTHONPATH=src python3 scripts/torch_example_quickstart.py [--device cpu]

Runs on the card by default (the kernels build on first use); ``--device
cpu`` runs the kernels' plain versions.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.core.device import LaunchConfig, resolve_device  # noqa: E402
from repro_torch.cv.imgproc import erode_vanherk  # noqa: E402
from repro_torch.data.synthetic import ImageStream  # noqa: E402
from repro_torch.kernels import bow, ops  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    dev = resolve_device(ap.parse_args().device)
    img = ImageStream().image((480, 640)).to(dev)
    print(f"image: {tuple(img.shape)} {img.dtype} on {dev}")

    # 1) Gaussian filter2D, the paper's first benchmark.  The launch shape is
    #    the port's counterpart of the paper's register-block knob: the same
    #    results from another tile.
    a = ops.gaussian_filter2d(img, 5, mode="window", lc=LaunchConfig(tile_rows=8, tile_cols=8))
    b = ops.gaussian_filter2d(img, 5, mode="window", lc=LaunchConfig())
    assert torch.equal(a, b), "the launch shape must not change results"
    diff = int((img.int() - b.int()).abs().max())
    print(f"filter2D ok: 8x8 and 32x32 tiles agree; max |img - blur| = {diff}")

    # 2) Erosion, the paper's second benchmark, and the van Herk variant
    er = ops.erode(img, 2)
    assert torch.equal(er, erode_vanherk(img, 2))
    print("erode ok: the fused-stencil erode == van Herk O(1)-a-pixel variant")

    # 3) BoW assignment: the nearest-word kernel against its plain version
    g = torch.Generator().manual_seed(0)
    desc = torch.randn((512, 128), generator=g).to(dev)
    cents = torch.randn((250, 128), generator=g).to(dev)
    idx, _ = bow.bow_assign(desc, cents)
    ridx, _ = bow.bow_assign_plain(desc, cents)
    agree = float((idx == ridx).float().mean()) * 100
    print(f"bow ok: {agree:.1f}% argmin agreement with the plain version")
    return 0 if agree == 100.0 else 1


if __name__ == "__main__":
    sys.exit(main())
