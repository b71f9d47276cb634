"""End-to-end BoW + SVM image classification, the paper's §4.5 pipeline (the
counterpart of `examples/bow_classifier.py`).

    PYTHONPATH=src python3 scripts/torch_example_bow_classifier.py [--device cpu]

Trains on 200 synthetic CIFAR-like images (64 words, 16 keypoints an
image) and reports the accuracy on 100 more with the predict stages'
times.  Runs on the card by default; ``--device cpu`` runs the kernels'
plain versions.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.core.device import resolve_device  # noqa: E402
from repro_torch.cv import pipeline  # noqa: E402
from repro_torch.cv.config import PipelineConfig  # noqa: E402
from repro_torch.data.synthetic import ImageStream  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    dev = resolve_device(ap.parse_args().device)
    stream = ImageStream()
    # integer splits: the same images in every process
    xtr, ytr = stream.batch(200, split=0)
    xte, yte = stream.batch(100, split=1)
    print(f"train {tuple(xtr.shape)}, test {tuple(xte.shape)} (synthetic CIFAR-like, 10 classes)")
    cfg = PipelineConfig(max_kp=16)
    model = pipeline.train(xtr, ytr, cfg, dict_size=64, generator=torch.Generator().manual_seed(0),
                           device=dev)
    timing = {}
    pred = pipeline.predict(model, xte, cfg, device=dev, timing=timing)
    acc = float((pred.cpu().long() == yte.long()).float().mean())
    print(f"accuracy: {acc * 100:.1f}% (chance 10%) on {dev}")
    for stage, sec in timing.items():
        print(f"  {stage:20s} {sec:.3f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
