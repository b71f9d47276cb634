"""The CV serving mesh (the counterpart of `repro.launch.mesh.make_cv_mesh`).

A mesh here is only the devices of one "data" axis: the CV batch path is
pure data parallelism, and PyTorch has no `shard_map` layout to attach.
The other mesh builders of the JAX module (`make_mesh`,
`make_production_mesh`, `make_host_mesh`) belong to the LM stack's
sharding (ROADMAP Queue 1 item 8, step 9).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core.device import resolve_device


@dataclass(frozen=True)
class CvMesh:
    """A one-axis device mesh: ``axis_names == ("data",)``, `devices` the
    `torch.device`s along it, in shard order."""

    devices: tuple
    axis_names: tuple = ("data",)


def make_cv_mesh(data: int | None = None, *, device=None) -> CvMesh:
    """Data-only mesh for the CV serving fan-out (`serve.shard_dispatch`).

    On the card (`device` None or CUDA) it covers the first
    `torch.cuda.device_count()` CUDA devices, capped at `data` when given;
    ``device="cpu"`` gives a one-device CPU mesh.  A one-device mesh leaves
    `CvEngine` serving as without one (the dispatcher engages past one
    data-axis device)."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return CvMesh(devices=(torch.device("cpu"),))
    n = torch.cuda.device_count()
    data = n if data is None else max(1, min(int(data), n))
    return CvMesh(devices=tuple(torch.device("cuda", i) for i in range(data)))
